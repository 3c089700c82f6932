"""Training steps, the staged-unfreeze schedule and data-parallel process groups."""
