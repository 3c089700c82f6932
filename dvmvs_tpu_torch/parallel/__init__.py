"""Training steps and the staged-unfreeze schedule."""
