"""Training: losses, Adam, the train step (FLAME-bound or unbound) and the host loop."""
