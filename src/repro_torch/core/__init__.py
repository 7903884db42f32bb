"""Core query path of the port: graph, store, search phases, engine."""
