"""The per-pod scheduling framework: extension-point interfaces, the
cycle state, the runtime that runs the plugins, and the plugins."""
