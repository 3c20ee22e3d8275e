"""Label-variant birdview renderer.

The reference ships birdview/chauffeurnet_label.py as a byte-identical copy
of chauffeurnet.py (apart from one comment) and selects it under the
``birdview_label`` obs key so the DataWriter can store a label-quality render
(reference: carla_gym/core/obs_manager/birdview/chauffeurnet_label.py,
config/data_collect.yaml agent.my.obs_configs). One implementation serves
both registry names here.
"""

from muvo_tpu_torch.sim.obs_managers.birdview.chauffeurnet import ObsManager

__all__ = ["ObsManager"]
