"""VAE data building, training, normative z-scores and checkpoints."""
