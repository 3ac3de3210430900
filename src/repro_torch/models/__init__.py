"""Model layers of the port (counterpart of ``repro.models``): so far the
attention and gated-MLP blocks the query encoder runs."""
