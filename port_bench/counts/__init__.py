"""Operation and byte counts of the work each family's fit needs, as
functions of the shapes."""
