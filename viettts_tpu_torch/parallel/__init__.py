"""The port's multi-device layer: one process per device over
``torch.distributed`` (``parallel/mesh.py``)."""
