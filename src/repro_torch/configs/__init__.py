"""Model configurations: the ten assigned architectures and their smoke
twins (:mod:`repro_torch.configs.registry`), copied from the reference
with ``ModelConfig.compute_dtype`` a ``torch.dtype``."""
