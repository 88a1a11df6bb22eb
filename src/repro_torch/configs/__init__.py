"""Architecture configs of the port (port of ``repro.configs``): the
config dataclass and the dense GQA, MoE, SSM and hybrid architectures the
LM serving path runs."""
