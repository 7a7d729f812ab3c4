"""Configuration shim, box codec and camera geometry."""
