"""lesionvae_tpu_torch.viz"""
