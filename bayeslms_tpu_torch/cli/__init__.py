"""Command-line interface of the port (``bayeslm-torch``)."""
