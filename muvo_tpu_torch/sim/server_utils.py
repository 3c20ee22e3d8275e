"""CARLA server lifecycle management.

Counterpart of reference utils/server_utils.py: spawn one or more CARLA
server processes (one per GPU / port), kill them by port, and restart on
demand for the collection crash-recovery loop.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, List, Optional


def kill_carla(port: Optional[int] = None):
    """Kill CARLA servers (by RPC port when given, else all)."""
    if port is None:
        cmd = ["pkill", "-f", "CarlaUE4"]
    else:
        cmd = ["fuser", "-k", f"{port}/tcp"]
    subprocess.run(cmd, capture_output=True)
    time.sleep(1.0)


class CarlaServerManager:
    def __init__(self, carla_sh_path: str, port: int = 2000,
                 configs: Optional[List[Dict]] = None, t_sleep: int = 5):
        self._carla_sh = carla_sh_path
        self._t_sleep = t_sleep
        self._processes: List[subprocess.Popen] = []
        if configs is None:
            self._configs = [{"gpu": 0, "port": port}]
        else:
            self._configs = configs

    def start(self):
        self.stop()
        for cfg in self._configs:
            cmd = (
                f"CUDA_VISIBLE_DEVICES={cfg.get('gpu', 0)} bash "
                f"{self._carla_sh} -fps=10 -quality-level=Epic "
                f"-carla-rpc-port={cfg['port']} -RenderOffScreen -nosound"
            )
            print(f"starting carla: {cmd}")
            proc = subprocess.Popen(cmd, shell=True,
                                    preexec_fn=os.setsid)
            self._processes.append(proc)
        time.sleep(self._t_sleep)

    def stop(self):
        for cfg in self._configs:
            kill_carla(cfg["port"])
        for proc in self._processes:
            try:
                proc.terminate()
            except Exception:
                pass
        self._processes = []
        time.sleep(self._t_sleep)

    def restart(self):
        self.stop()
        self.start()
