"""Processing graphs of the port: the effect chain (``graph.fx``)."""
