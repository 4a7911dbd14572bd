"""The plain layout of `mixed_primitives.json`'s scene (examples3d/
primitives3.rs:13-60 shapes, as the bench scene lays them out): a fixed
ground cuboid (100.1, 2.1, 100.1) at y = -2.1, then `num_layers` layers of
`grid` x `grid` bodies of radius `rad`, 2.5 rad apart, layer j at
y = 5 rad j + rad + 2 and shifted by 0.02 j in x and z; ball(rad),
cuboid(rad, rad, rad) and capsule_y(rad / 2, rad / 2) cycle by layer."""

from port_bench.reference.masses import BALL, CUBOID, capsule_y, with_masses


def layout(num_layers: int, grid: int, rad: float):
    shift = rad * 2.5
    center = shift * (grid - 1) / 2.0
    kinds = [(BALL, (rad,)), (CUBOID, (rad, rad, rad)), capsule_y(rad * 0.5, rad * 0.5)]
    out = [dict(pos=(0.0, -2.1, 0.0), shape=CUBOID, params=(100.1, 2.1, 100.1), dynamic=False)]
    for j in range(num_layers):
        y = j * shift * 2.0 + rad + 2.0
        for i in range(grid):
            for k in range(grid):
                shape, prm = kinds[j % 3]
                out.append(dict(pos=(i * shift - center + 0.02 * j, y,
                                     k * shift - center + 0.02 * j),
                                shape=shape, params=prm, dynamic=True))
    return with_masses(out)
