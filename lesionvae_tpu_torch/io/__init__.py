"""lesionvae_tpu_torch.io"""
