"""One module a model family: its data, its model, what each fit leaves
to compare, and the comparison that decides ``correct``."""
