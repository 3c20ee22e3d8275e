"""Surrounding-pedestrian finder
(reference: obs_manager/object_finder/pedestrian.py)."""

from muvo_tpu_torch.sim.obs_managers.object_finder.vehicle import (  # noqa: F401
    PedestrianObsManager as ObsManager,
)
