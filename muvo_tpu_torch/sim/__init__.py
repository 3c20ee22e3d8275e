"""Own copies of muvo_tpu/sim/: the shaped reward, the CARLA-free
kinematic driving env, the CARLA gym envs and their handlers, observation
managers and scenario descriptions, the route planner and scripted
agents, and the episode recorder (tests/test_torch_isolation.py holds
each to its original)."""
