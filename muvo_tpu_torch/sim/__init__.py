"""Own copies of muvo_tpu/sim/'s numpy-only modules: the shaped reward
and the CARLA-free kinematic driving env (tests/test_torch_isolation.py
holds them equal to the originals)."""
