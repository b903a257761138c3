"""The forward wrapper's calls (``ops/conv3x3.py::conv3x3_nopad``) in one
training step of each of the benchmark's two cells, ``cifar10_4k.train``
and ``cifar10_snresnet.train`` (float32, batch 100; D's update runs D at
300 rows), keyed (role, N, H, W, Cin, Cout, halo) as ``fwd_launches`` keys
them, with the calls a step in each cell: counted by a spy on the wrapper
over one step of ``make_device_train_step`` at each configuration's
widths. Shared by the CPU test of the Winograd rule and the card tests of
the pipeline, so it imports nothing."""

CELL_CONVS = {
    ('dgrad', 100, 4, 4, 1024, 512, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 6, 6, 512, 256, 2): {'cifar10_4k': 3, 'cifar10_snresnet': 3},
    ('dgrad', 100, 8, 8, 128, 74, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 8, 8, 128, 128, 1): {'cifar10_snresnet': 4},
    ('dgrad', 100, 8, 8, 256, 256, 1): {'cifar10_snresnet': 2},
    ('dgrad', 100, 8, 8, 512, 256, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 16, 16, 12, 128, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 16, 16, 64, 42, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 16, 16, 128, 128, 1): {'cifar10_snresnet': 2},
    ('dgrad', 100, 16, 16, 256, 128, 1): {'cifar10_4k': 3, 'cifar10_snresnet': 3},
    ('dgrad', 100, 16, 16, 256, 256, 1): {'cifar10_4k': 6, 'cifar10_snresnet': 8},
    ('dgrad', 100, 32, 32, 3, 256, 1): {'cifar10_snresnet': 1},
    ('dgrad', 100, 32, 32, 32, 13, 1): {'cifar10_4k': 1},
    ('dgrad', 100, 32, 32, 128, 3, 1): {'cifar10_snresnet': 1},
    ('dgrad', 100, 32, 32, 128, 128, 1): {'cifar10_4k': 6, 'cifar10_snresnet': 7},
    ('dgrad', 100, 32, 32, 256, 256, 1): {'cifar10_snresnet': 2},
    ('dgrad', 300, 8, 8, 128, 74, 1): {'cifar10_4k': 1},
    ('dgrad', 300, 8, 8, 128, 128, 1): {'cifar10_snresnet': 4},
    ('dgrad', 300, 16, 16, 64, 42, 1): {'cifar10_4k': 1},
    ('dgrad', 300, 16, 16, 128, 128, 1): {'cifar10_snresnet': 2},
    ('dgrad', 300, 32, 32, 128, 128, 1): {'cifar10_snresnet': 1},
    ('fwd', 100, 4, 4, 512, 1024, 1): {'cifar10_4k': 3},
    ('fwd', 100, 8, 8, 74, 128, 1): {'cifar10_4k': 2},
    ('fwd', 100, 8, 8, 128, 128, 1): {'cifar10_snresnet': 8},
    ('fwd', 100, 8, 8, 256, 256, 1): {'cifar10_snresnet': 6},
    ('fwd', 100, 8, 8, 256, 512, 0): {'cifar10_4k': 4, 'cifar10_snresnet': 4},
    ('fwd', 100, 8, 8, 256, 512, 1): {'cifar10_4k': 3},
    ('fwd', 100, 16, 16, 42, 64, 1): {'cifar10_4k': 2},
    ('fwd', 100, 16, 16, 128, 12, 1): {'cifar10_4k': 3},
    ('fwd', 100, 16, 16, 128, 128, 1): {'cifar10_snresnet': 4},
    ('fwd', 100, 16, 16, 128, 256, 1): {'cifar10_4k': 4, 'cifar10_snresnet': 4},
    ('fwd', 100, 16, 16, 256, 256, 1): {'cifar10_4k': 8, 'cifar10_snresnet': 14},
    ('fwd', 100, 32, 32, 3, 128, 1): {'cifar10_4k': 4, 'cifar10_snresnet': 6},
    ('fwd', 100, 32, 32, 13, 32, 1): {'cifar10_4k': 2},
    ('fwd', 100, 32, 32, 128, 128, 1): {'cifar10_4k': 8, 'cifar10_snresnet': 10},
    ('fwd', 100, 32, 32, 256, 3, 1): {'cifar10_snresnet': 3},
    ('fwd', 100, 32, 32, 256, 256, 1): {'cifar10_snresnet': 6},
    ('fwd', 300, 8, 8, 74, 128, 1): {'cifar10_4k': 1},
    ('fwd', 300, 8, 8, 128, 128, 1): {'cifar10_snresnet': 4},
    ('fwd', 300, 16, 16, 42, 64, 1): {'cifar10_4k': 1},
    ('fwd', 300, 16, 16, 128, 128, 1): {'cifar10_snresnet': 2},
    ('fwd', 300, 32, 32, 3, 128, 1): {'cifar10_snresnet': 1},
    ('fwd', 300, 32, 32, 13, 32, 1): {'cifar10_4k': 1},
    ('fwd', 300, 32, 32, 128, 128, 1): {'cifar10_snresnet': 1},
}
