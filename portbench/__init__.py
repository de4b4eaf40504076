"""The port's benchmark: whole VAE training jobs of ``lesionvae_tpu_torch``
on one card, driven from ``BENCHMARK.json`` (``python3 -m portbench.run``)."""
