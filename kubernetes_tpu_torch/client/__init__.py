"""Clients of the store: the event recorder, work queues and shared
informers."""
