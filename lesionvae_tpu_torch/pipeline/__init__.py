"""lesionvae_tpu_torch.pipeline"""
