"""Clients of the store: the event recorder."""
