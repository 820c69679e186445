"""Controller scaffolding: informer events to a workqueue to reconcile
workers."""
