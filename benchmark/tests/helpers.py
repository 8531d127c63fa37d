"""Helpers of the benchmark's own tests."""


def small_cell(name: str):
    """The cell `name` cut for a CPU run: a fleet to 8 lanes, every lane-tick
    compared; a map build to a 1 m square of the map with 10 trunks in it
    (the arithmetic of a tick or of a cell's fit is the same at any
    width)."""
    from benchmark.core import cells
    cell = cells.resolve(name)
    t = dict(cell.traffic, traced_units=1)
    if t["driver"] == "fleet":
        t.update(lanes=8, warm_ticks=1, check={"tick_share": 1.0, "lanes": 8})
        return cell._replace(traffic=t)
    # trunks stand inside the square, as they do in the full map's corner
    cloud = dict(t["cloud"], trunks=10, trunk_box=[[-0.5, 0.5], [-0.5, 0.5]])
    t.update(cloud=cloud, check={"cells": 64})
    m = dict(cell.config["map"], map_size_x=1.0, map_size_y=1.0)
    return cell._replace(traffic=t, config=dict(cell.config, map=m))
