"""Examples of the port, runnable as modules."""
