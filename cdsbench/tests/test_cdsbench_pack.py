"""The resident shard's planes, packed from COO elements made on the
device, equal the program's pack of the dense stack of the same
columns."""

import torch

from cdsbench import data as D
from cdsbench.run import pack_resident
from cdsbench.tests.tiny_cell import SEEDS, tiny_cell


def test_resident_pack_equals_the_programs_pack():
    from colormipsearch_tpu_torch.engine import cds

    _cell, config, traffic, _bench = tiny_cell()
    thr = config["params"]["dataThreshold"]
    d = D.make_cell_data(SEEDS[8], config, traffic)
    cpu = torch.device("cpu")
    want = cds._pack_target_stack(D.fill_stack(d), 64, "keys", thr, cpu)
    got = pack_resident(d, 64, thr, cpu)
    assert torch.equal(got, want)
