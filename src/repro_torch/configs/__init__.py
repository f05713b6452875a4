"""One module per selectable architecture (``--arch <id>``): the ten
assigned LM configs and the paper's three basecallers, the same ids as
the reference's ``repro.configs``. Importing a module registers its
config into :mod:`repro_torch.config`; ``config.get_config`` imports
them all."""
__all__: list = []
