"""chip_smoke.py's kernel table: every kernel names the TPU kernel or JAX
function it replaces as "path:line", and that line (or one of the two
after it) of the JAX package or tools holds that function's `def`, or
the `pallas_call` of a Pallas kernel.  Imported without a card."""

from pathlib import Path

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", list(chip_smoke.KERNELS))
def test_replaces_points_at_the_function(name):
    source, replaces, what = chip_smoke.KERNELS[name]
    assert (REPO / source).is_file(), source
    path, line = replaces.rsplit(":", 1)
    lines = (REPO / path).read_text().splitlines()
    window = lines[int(line) - 1:int(line) + 2]
    want = "pl.pallas_call(" if what == "pallas_call" else f"def {what}("
    assert any(want in ln for ln in window), (replaces, want, window)


def test_every_dp_variant_and_main_kernel_is_listed():
    names = set(chip_smoke.KERNELS)
    assert set(chip_smoke.DP_VARIANTS.values()) <= names
    assert set(chip_smoke.SPLIT_VARIANTS.values()) <= names
    assert set(chip_smoke.SPLIT16_VARIANTS.values()) <= names
    # The 16-bit split kernel at every interleave, and its plane-2 form:
    # interleave 1 replaces the one-stream pallas_call, 2 and 4 the stream
    # kernel's, plane 2 the probe's.
    for (fmt, il), name in chip_smoke.SPLIT16_VARIANTS.items():
        assert chip_smoke.KERNELS[name][:2] == (
            "darwin_tpu_torch/csrc/dp16.cu",
            "darwin_tpu/ops/pallas_dp.py:" + ("523" if il == 1 else "493"))
    assert {"align_tiles[bytes,il=2,split16]",
            "align_tiles[packed6,il=4,split16]"} <= names
    for name in (chip_smoke.PLANE2_SPLIT16, chip_smoke.PLANE2_SPLIT):
        assert chip_smoke.KERNELS[name][1] == "tools/plane2_probe.py:209"
    for tag in chip_smoke.SPLIT_ECOLI_RUNS:
        for T in chip_smoke.SPLIT_ECOLI:
            assert set(chip_smoke.split_ecoli_kernels(tag, T)) <= names
    assert {"traceback", "traceback_packed", "traceback_packed6",
            "fetch_tiles", "local_score_batch", "plane2", "scanshift_shfl",
            "scanshift_smem", "dsoft_device", "dsoft_shard_scan",
            "dsoft_shard_count"} <= names
    for kernels in chip_smoke.ECOLI_RUNS.values():
        assert set(kernels) <= names
    assert "dsoft_device" in chip_smoke.ECOLI_RUNS["cli bytes --dsoft device"]
    # The table-sharded D-SOFT's two kernels are the two per-read steps of
    # one XLA function (its per-device body), so they share its line and
    # stay out of the one-function-one-kernel list below.
    assert chip_smoke.KERNELS["dsoft_shard_scan"][1:] == \
        chip_smoke.KERNELS["dsoft_shard_count"][1:] == (
            "darwin_tpu/dsoft/sharded_table.py:265",
            "_dsoft_table_sharded_local")
    # The slot loop's two kernels are the engine's while_loop body less
    # its fetch, DP and walker, so they share its line.
    assert chip_smoke.KERNELS["slot_prepare"][1:] == \
        chip_smoke.KERNELS["slot_post"][1:] == (
            "darwin_tpu/engine/device_batch.py:240", "body")
    assert set(chip_smoke.SLOT_LOOP) <= set(
        chip_smoke.ECOLI_RUNS["cli bytes"])
    # One JAX function, one kernel: no two main kernels share a line.
    main = [chip_smoke.KERNELS[k][1] for k in
            ("traceback", "traceback_packed", "traceback_packed6",
             "local_score_batch", "fetch_tiles", "align_tiles",
             "dsoft_device")]
    assert len(set(main)) == len(main)
