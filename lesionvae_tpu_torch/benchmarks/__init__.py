"""Probes of the port on the card (each runnable with ``python -m``)."""
