"""The what-if studies on one card (``parallel.mesh``)."""
