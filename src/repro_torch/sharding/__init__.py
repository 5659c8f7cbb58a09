"""The sharding policy: logical axes to mesh axes, and to DTensor
placements on a ``DeviceMesh``."""
