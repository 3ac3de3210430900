"""Model layers of the port (counterpart of ``repro.models``): the blocks
of the query encoder and of the candidate LMs."""
