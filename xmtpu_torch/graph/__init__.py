"""Processing graphs of the port: the effect chain (``graph.fx``), the
mixer and the file pipeline (``graph.mixer``, ``graph.pipeline``), the
streaming session (``graph.streaming``), the session pool
(``graph.pool``) and the serving front end (``graph.serve``)."""
