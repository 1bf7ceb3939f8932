"""Data parallelism over video streams: B tracking sessions in one device
step (``multiseq``)."""
