"""Run supervision of the port: the event journal the checkpoint commit
protocol writes (``events``)."""
