"""Architecture configs of the port (port of ``repro.configs``): the
config dataclass and the dense GQA and MoE architectures the LM serving
path runs."""
