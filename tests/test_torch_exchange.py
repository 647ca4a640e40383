"""The port's exchange bucketize against the reference's on lanes outside
``[0, num_lanes)``: such a valid record gets slot 0, is not counted in its
lane and counts as overflow ("never silently dropped").  The scenarios are
the reference's own (``tests/test_exchange.py``'s out-of-range-lane test and
``tests/test_backends.py``'s scalar-only test), plus a longer stream with
invalid records and a full lane, run through ``Exchange.bucketize`` without
a slot so the slots come from ``dispatch_count``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exchange import ExchangeSpec as JSpec, Payload as JPayload
from repro.exchange.backends import _bucketize as j_bucketize
from repro_torch.exchange import ExchangeSpec, Payload, make_exchange

SCENARIOS = {
    # tests/test_exchange.py::test_bucketize_out_of_range_lane_counted
    "exchange_5_and_minus_2": ([0, 5, 1, -2, 1], None, 2, 4),
    # tests/test_backends.py::test_out_of_range_lane_counts_in_scalar_only
    "backends_7_and_minus_3": ([0, 7, -3], None, 2, 4),
    "long_with_invalid_and_full_lane": (
        [0, 5, 1, -1, 0, 3, 2, 7] + [1] * 504, [True] * 6 + [False] * 2 + [True] * 504, 4, 300),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_out_of_range_lanes_match_reference(name):
    lanes, valid, num_lanes, cap = SCENARIOS[name]
    lane = np.asarray(lanes, np.int32)
    valid = np.ones(len(lane), bool) if valid is None else np.asarray(valid)
    vals = np.arange(len(lane), dtype=np.float32) + 1.0
    want = j_bucketize(JSpec(num_lanes=num_lanes, capacity=cap), jnp.asarray(lane),
                       jnp.asarray(valid), [JPayload(jnp.asarray(vals), 0.0)])
    ex = make_exchange(ExchangeSpec(num_lanes=num_lanes, capacity=cap))
    got = ex.bucketize(torch.as_tensor(lane)[None], torch.as_tensor(valid)[None],
                       [Payload(torch.as_tensor(vals)[None], 0.0)])
    assert int(got.send.overflow[0]) == int(want.send.overflow)
    for field in ("slot", "ok", "lane_overflow"):
        np.testing.assert_array_equal(getattr(got.send, field)[0].numpy(),
                                      np.asarray(getattr(want.send, field)), err_msg=field)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.payloads[0][0].numpy(), np.asarray(want.payloads[0]))
    # every valid record is either in a buffer or counted as overflow
    assert int(got.valid.sum()) + int(got.send.overflow.sum()) == int(valid.sum())
