"""The lesion-conditioned VAE: layers, model, ELBO, weight conversion."""
