"""Dynamic weather handler (reference: carla_gym/utils/dynamic_weather.py).

Presets by name or a 'dynamic_*' mode that continuously evolves sun altitude
and storm intensity.
"""

from __future__ import annotations

import math
from typing import Optional


class _Value:
    def __init__(self, value=0.0, vmin=0.0, vmax=100.0, speed=1.0):
        self.value, self.vmin, self.vmax, self.speed = value, vmin, vmax, speed

    def tick(self, delta):
        self.value = min(self.vmax, max(self.vmin, self.value + self.speed * delta))
        return self.value


class WeatherHandler:
    def __init__(self, world):
        self._world = world
        self._dynamic = False
        self._weather = None
        self._t = 0.0

    def reset(self, weather_cfg: Optional[str]):
        import carla

        if weather_cfg is None:
            weather_cfg = "ClearNoon"
        if str(weather_cfg).startswith("dynamic"):
            self._dynamic = True
            self._weather = getattr(carla.WeatherParameters, "ClearNoon")
            self._t = 0.0
        else:
            self._dynamic = False
            self._weather = getattr(carla.WeatherParameters, weather_cfg)
        self._world.set_weather(self._weather)

    def tick(self, delta_seconds: float):
        if not self._dynamic or self._weather is None:
            return
        self._t += delta_seconds
        # sun cycles over ~8 simulated minutes; storm builds and decays
        altitude = 70.0 * math.sin(2 * math.pi * self._t / 480.0)
        storm = 40.0 * (1 + math.sin(2 * math.pi * self._t / 300.0)) / 2
        self._weather.sun_altitude_angle = altitude
        self._weather.precipitation = storm
        self._weather.cloudiness = min(100.0, storm + 20.0)
        self._weather.wetness = storm
        self._world.set_weather(self._weather)

    def clean(self):
        pass
