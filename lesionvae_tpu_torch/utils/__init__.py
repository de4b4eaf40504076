"""lesionvae_tpu_torch.utils"""
