"""Training: losses, optimizer, steps, the fold loop and the k-fold runner."""
