"""The REST server of the port (``server.py``), on the card by default."""
