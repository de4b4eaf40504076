"""lesionvae_tpu_torch.core"""
