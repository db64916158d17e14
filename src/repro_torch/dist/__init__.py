"""Fault tolerance of the training loop (``fault.py``); the rest of
``repro.dist`` comes with ROADMAP queue 1 item 8."""
