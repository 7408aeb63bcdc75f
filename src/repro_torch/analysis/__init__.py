"""Device constants the port's models read (``roofline``)."""
