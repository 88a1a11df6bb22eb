"""Architecture configs of the port (port of ``repro.configs``): the
config dataclass and the dense GQA architectures the LM serving path
runs."""
