"""The plain reference of the benchmark's cells: the lesion-conditioned VAE
of the published model (akul0119/lesion-condition-vae ``vae_model.py``,
``LesionConditionedVAE``) in plain PyTorch, for a stack of S independent
members at once, with its data normalization, training (masked BatchNorm,
ELBO, clip -> decay -> Adam), normative summary and z-scores, and the order
in which a run draws its weights and noise from a seed.

It imports nothing of the program under test, nor JAX: everything it needs
is worked out here again from the seed and the inputs.  ``precision``
selects the configuration's arithmetic (float32 with TF32 off, or the
fleet's bfloat16 mixed precision) or the control's below it (TF32, float8
operands); ``store`` the bfloat16 store with stochastic rounding."""
