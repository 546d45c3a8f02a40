"""CPU checks of the u8 scan's measurement helpers in
``clip_codec_tpu_torch/probes/index_times.py``: the bounds ``--kernels``
prints, how a probe's pairs fall on the lists and the kernel's blocks, and
the device-side grouping pre-pass it times against the kernel's own
grouping. The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from clip_codec_tpu_torch.probes import index_times as it


def test_index_times_bounds_are_bytes_or_the_split_products():
    """``--kernels``' least times at phase 19's Q = 64 shapes: the scan of 1M
    rows and the full probe are bound by bytes, just above their three-part
    bf16 products; an fp32 scan would be bound by its FMA pipe."""
    scan = it.scan_bounds(it.scores_bytes(64, 1_000_000, 512), 64 * 1_000_000 * 512)
    assert scan["bytes"] == pytest.approx(0.2305, abs=1e-4) and scan["split bf16"] == pytest.approx(0.1988, abs=1e-4)
    assert scan["fp32 FMA"] == pytest.approx(0.9781, abs=1e-4)
    probe = it.scan_bounds(it.probe_bytes(316, 370, 64, 316, 512), 64 * 316 * 370 * 512)
    assert probe["bytes"] == pytest.approx(0.0270, abs=1e-4) and probe["split bf16"] < probe["bytes"]


def test_index_times_kernels_mode_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        it.main(["--kernels"])
    assert e.value.code == 2


def _probe(seed, q, nprobe, nlist):
    """q rows of nprobe ids each in [0, nlist), list 1 in every row, one
    row naming list 2 twice, and lists past nlist // 2 never named."""
    probe = np.random.default_rng(seed).integers(0, nlist // 2, (q, nprobe)).astype(np.int32)
    probe[:, 0] = 1
    probe[0, 1:3] = 2
    return probe


@pytest.mark.parametrize("q,nprobe,nlist", [(13, 5, 9), (40, 8, 30)])
def test_grouping_prepass_matches_a_numpy_loop(q, nprobe, nlist):
    """Each list's pairs ascending from its start, a list named twice in one
    row giving both pairs, an unprobed list an empty span."""
    probe = _probe(q, q, nprobe, nlist)
    order, starts = it.grouping_prepass(torch.from_numpy(probe), nlist)
    assert order.dtype == starts.dtype == torch.int32 and starts.shape == (nlist + 1,)
    flat, order, starts = probe.reshape(-1), order.numpy(), starts.numpy()
    for lst in range(nlist):
        assert order[starts[lst]:starts[lst + 1]].tolist() == [p for p in range(flat.size) if flat[p] == lst]
    assert starts[-1] == flat.size


@pytest.mark.parametrize("q,nprobe,nlist,cap,sms", [(13, 5, 9, 40, 4), (40, 8, 30, 600, 7), (2, 8, 30, 600, 7)])
def test_probe_skew_matches_a_numpy_loop(q, nprobe, nlist, cap, sms):
    """Pairs, lists and the most pairs a list against a loop over the ids;
    past 128 pairs, the kernel's round robin of every list's tiles over its
    blocks (512-row tiles at Q > 4) against a loop over the blocks."""
    probe = _probe(q, q, nprobe, nlist)
    got = it.probe_skew(torch.from_numpy(probe), nlist, cap, sms)
    counts = [int((probe == lst).sum()) for lst in range(nlist)]
    assert got["pairs"] == q * nprobe and got["max_pairs_a_list"] == max(counts)
    assert got["lists"] == sum(c > 0 for c in counts)
    if q * nprobe <= 128:
        assert set(got) == {"pairs", "lists", "max_pairs_a_list"}
        return
    tiles = -(-cap // 512)
    items = [(lst, t) for lst in range(nlist) for t in range(tiles)]
    g = min(len(items), sms)
    mine = [[counts[lst] for j, (lst, _) in enumerate(items) if j % g == b] for b in range(g)]
    assert got["block_max_probed_tiles"] == max(sum(c > 0 for c in m) for m in mine)
    assert got["block_max_pairs"] == max(sum(m) for m in mine)
    assert got["dealt_probed_tiles"] == -(-sum(counts[lst] > 0 for lst, _ in items) // g)
