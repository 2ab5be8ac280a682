"""Offline tools of the port: ``pack_h5`` (``cli pack-h5``)."""
