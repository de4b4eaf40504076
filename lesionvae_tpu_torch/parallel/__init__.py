"""Multi-rank execution on ``torch.distributed`` (the port of lesionvae_tpu/parallel)."""
