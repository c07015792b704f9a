"""Training on one CUDA card: loss, optimizer and train state, full-state
checkpoints, datasets and the Trainer (the JAX package's train/)."""
