"""Training: optimizer, train step, checkpoints and HadarE consolidation."""
