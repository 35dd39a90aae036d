"""chip_smoke.py's phases at tiny sizes on the CPU: the same code paths
and checks the GPU run takes, so a wrong path, argument or comparison
shows here before it costs a chip run.  main() itself must refuse to run
without a GPU."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from libzseek_jax.testing import golden

pytestmark = [pytest.mark.usefixtures("native_lib"),
              pytest.mark.skipif(not (golden.have_zstd()
                                      and golden.have_lz4()),
                                 reason="stock libzstd/liblz4 unavailable")]

FRAME = 1 << 18


@pytest.fixture(scope="module")
def data():
    return cs.make_data(5, 2 << 20)


@pytest.fixture(scope="module")
def archive(data):
    return cs.phase_a_zstd_write(data, frame=FRAME)


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    assert capsys.readouterr().out == ""


def test_phase_a_zstd_write(archive, data):
    arc, res = archive
    assert res["frames"] == len(data) // FRAME
    assert res["bytes_out"] == len(arc) < len(data)


def test_phase_b_reads(archive, data):
    res = cs.phase_b_reads(archive[0], data, n_reads=40, cache_frames=4)
    assert res["reads"] == 40 and 0 <= res["hit_rate"] <= 1
    assert res["p50_ms"] <= res["p99_ms"]


def test_zipf_offsets_are_skewed_and_aligned():
    offs = cs.zipf_offsets(np.random.default_rng(0), 1 << 24, 4000, 4096)
    assert (offs % 4096 == 0).all() and offs.max() < 1 << 24
    # theta 0.99 over 4096 pages: the hottest page takes a few percent
    _, counts = np.unique(offs, return_counts=True)
    assert counts.max() > 40 and len(counts) < 4000


def test_phase_c_device_decode(archive, data):
    res = cs.phase_c_device_decode(archive[0], data, n_frames=4)
    assert res["frames"] == 4 and res["bytes"] == 4 * FRAME


def test_phase_d_foreign():
    res = cs.phase_d_foreign(7, total=1 << 20, frame=1 << 19)
    assert res["frames"] == 2 and res["ratio"] > 1


def test_phase_e_lz4(data):
    res = cs.phase_e_lz4(data[: 1 << 20], n_reads=20, frame=FRAME)
    assert res["frames"] == 4 and res["ratio"] > 1


def test_phase_f_identity(data):
    res = cs.phase_f_identity(data[: 1 << 19], frame=FRAME)
    assert res["source"]["bytes_in"] > 500_000


def test_phase_g_stages(data):
    res = cs.phase_g_stages(data, n_blocks=8)
    assert set(res) == {"zstd_sequences", "huffman_encode_literals",
                        "fse_encode_sequences", "huf_decode_lanes",
                        "fse_decode_seq_lanes", "huf_decode_anchored",
                        "fse_decode_anchored", "execute_sequences"}
    assert res["zstd_sequences"]["arg_shapes"][0] == [8, 131072]
    assert all(r["warm_ms"] > 0 for r in res.values())


def test_phase_cards_on_virtual_devices(data):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    # 32 frames in Writer batches of 8: one parse batch per device
    res = cs.phase_cards(data, 4, frame=1 << 16)
    assert len(res["batches_per_device"]) == 4
