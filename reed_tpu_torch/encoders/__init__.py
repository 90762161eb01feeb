"""Weight conversion between the port and reed_tpu / reference checkpoints."""
