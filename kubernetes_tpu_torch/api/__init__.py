"""Object model, interning and the snapshot encoder."""
