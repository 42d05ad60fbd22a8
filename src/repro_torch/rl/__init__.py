"""RL layer of the port: the acting / serving path (``actor``)."""
