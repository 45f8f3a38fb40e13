"""The README's demo in the port (counterpart of ``examples/``)."""
