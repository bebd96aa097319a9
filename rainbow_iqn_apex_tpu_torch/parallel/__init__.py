"""Train-loop supervision of the port (``supervisor.py``)."""
