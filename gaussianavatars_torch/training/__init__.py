"""Training: losses, Adam and the FLAME-bound train step."""
