"""Tools over parameter trees: int8 weight-only quantisation for
serving (``surgery``)."""
