"""Serving: the per-replica engine and the DR session router (a port of
``repro.serve``)."""
