"""Command-line entry points of the port (port of ``repro.launch``)."""
