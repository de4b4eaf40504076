"""lesionvae_tpu_torch.ops"""
