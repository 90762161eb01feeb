"""Sample generation for evaluation."""
