"""The LM serving path of the port (port of ``repro.models``, dense GQA
family): layers, attention with cluster-major k²-attention decode, the
KV-cache clustering, the layer stack and the model's entry points."""
