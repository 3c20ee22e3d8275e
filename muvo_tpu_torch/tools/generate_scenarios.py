"""Generate LeaderBoard scenario descriptions (routes.xml + actors.json).

The port's counterpart of muvo_tpu's tools/generate_scenarios.py: the same
files for the same town and seed, on the port's own sim/carla_map_adapter.py
and sim/route_planner.py.

The reference ships hand-curated route XMLs under
carla_gym/envs/scenario_descriptions/LeaderBoard/<Town>/ (schema:
<routes><route id><ego_vehicle id="hero"><waypoint x y z pitch yaw roll/>...).
Those are data assets we regenerate rather than copy: pointed at a live CARLA
server this tool samples spawn-point pairs, traces each route through the
global planner, and writes the same schema. `--synthetic` emits
deterministic sample circuits without CARLA so LeaderboardEnv stays
constructible (and testable) in CARLA-less environments.

Usage:
  python -m muvo_tpu_torch.tools.generate_scenarios --town Town01 \
      --n-routes 10 --out muvo_tpu_torch/sim/scenario_descriptions
  python -m muvo_tpu_torch.tools.generate_scenarios --town Town01 \
      --synthetic --out ...
"""

from __future__ import annotations

import argparse
import json
import os
import xml.etree.ElementTree as ET

import numpy as np


def _waypoint_el(parent, x, y, z, pitch=0.0, yaw=0.0, roll=0.0):
    ET.SubElement(parent, "waypoint", {
        "x": f"{x}", "y": f"{y}", "z": f"{z}",
        "pitch": f"{pitch}", "yaw": f"{yaw}", "roll": f"{roll}",
    })


def synthetic_routes(town: str, n_routes: int, seed: int = 0):
    """Deterministic rectangular circuits (synthetic sample data, NOT real
    town geometry — regenerate against CARLA for on-map routes)."""
    rng = np.random.RandomState(seed + sum(map(ord, town)))
    routes = []
    for _ in range(n_routes):
        x0, y0 = rng.uniform(20, 300, 2)
        w, h = rng.uniform(40, 120, 2)
        corners = [(x0, y0, 0.0), (x0 + w, y0, 90.0),
                   (x0 + w, y0 + h, 180.0), (x0, y0 + h, 270.0),
                   (x0, y0, 0.0)]
        routes.append([(x, y, 0.0, 0.0, yaw, 0.0) for x, y, yaw in corners])
    return routes


def carla_routes(town: str, n_routes: int, host: str, port: int,
                 seed: int = 0, min_length: float = 200.0):
    """Sample spawn-point pairs from a live server and plan routes."""
    import carla

    client = carla.Client(host, port)
    client.set_timeout(60.0)
    world = client.load_world(town)
    spawn_points = world.get_map().get_spawn_points()
    rng = np.random.RandomState(seed)

    from muvo_tpu_torch.sim.carla_map_adapter import build_segments
    from muvo_tpu_torch.sim.route_planner import GlobalRoutePlanner

    planner = GlobalRoutePlanner(build_segments(world.get_map()))
    routes = []
    attempts = 0
    while len(routes) < n_routes and attempts < n_routes * 20:
        attempts += 1
        a, b = rng.choice(len(spawn_points), 2, replace=False)
        start, end = spawn_points[a], spawn_points[b]
        traced = planner.trace_route(
            (start.location.x, start.location.y, start.location.z),
            (end.location.x, end.location.y, end.location.z))
        if not traced:
            continue
        length = sum(
            float(np.linalg.norm(np.asarray(traced[i + 1][0])
                                 - np.asarray(traced[i][0])))
            for i in range(len(traced) - 1))
        if length < min_length:
            continue
        # keep sparse waypoints like the reference files (~every 50 m)
        keep = traced[:: max(1, len(traced) // 12)]
        wps = [(start.location.x, start.location.y, start.location.z,
                start.rotation.pitch, start.rotation.yaw,
                start.rotation.roll)]
        wps += [(p[0][0], p[0][1], p[0][2], 0.0, 0.0, 0.0) for p in keep[1:]]
        routes.append(wps)
    return routes


def write_description(out_dir: str, routes, ego_model="vehicle.lincoln.mkz_2017"):
    os.makedirs(out_dir, exist_ok=True)
    root = ET.Element("routes")
    for rid, wps in enumerate(routes):
        route = ET.SubElement(root, "route", {"id": str(rid)})
        ego = ET.SubElement(route, "ego_vehicle", {"id": "hero"})
        for wp in wps:
            _waypoint_el(ego, *wp)
    ET.indent(root)
    ET.ElementTree(root).write(os.path.join(out_dir, "routes.xml"),
                               encoding="UTF-8", xml_declaration=True)
    with open(os.path.join(out_dir, "actors.json"), "w") as f:
        json.dump({"ego_vehicles": {"hero": {"model": ego_model}}}, f,
                  indent=4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--town", required=True)
    ap.add_argument("--n-routes", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "sim", "scenario_descriptions"))
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="emit schema-valid sample circuits without CARLA")
    args = ap.parse_args(argv)

    if args.synthetic:
        routes = synthetic_routes(args.town, args.n_routes, args.seed)
    else:
        routes = carla_routes(args.town, args.n_routes, args.host, args.port,
                              args.seed)
    out_dir = os.path.join(args.out, "LeaderBoard", args.town)
    write_description(out_dir, routes)
    print(f"wrote {len(routes)} routes to {out_dir}")


if __name__ == "__main__":
    main()
