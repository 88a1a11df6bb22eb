"""Architecture configs of the port (port of ``repro.configs``): the
config dataclass and the dense GQA, MoE, SSM, hybrid, VLM and audio
architectures the LM serving path runs."""
