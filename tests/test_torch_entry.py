"""hpfw_tpu_torch.graft_entry against __graft_entry__, on the CPU.

entry(device="cpu") hands out the reference's example arguments bit for bit;
its forward step (the plain CQT and encoder) and the reference's, jitted as
__graft_entry__.py's __main__ runs it, each pass the float64 oracle's margin
audit, and they differ from each other only at free bits, by position too.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hpfw_tpu import oracle
from hpfw_tpu.config import HpfwConfig
from hpfw_tpu_torch import graft_entry
from hpfw_tpu_torch.oracle import audit
from hpfw_tpu_torch.parallel import dryrun
from test_tpu_pipeline import assert_bits_match_with_margin_audit


@pytest.fixture(scope="module")
def outputs():
    fn, args = graft.entry()
    forward, port_args = graft_entry.entry(device="cpu")
    pcm, filters = (np.asarray(a) for a in args)
    cfg = HpfwConfig()
    return dict(args=(pcm, filters), port_args=port_args,
                ref=np.asarray(jax.jit(fn)(*args)),
                port=forward(*port_args),
                oracle=oracle.fingerprint(pcm, filters, cfg),
                margins=oracle.delta_margins(pcm, filters, cfg))


def test_arguments_bit_equal(outputs):
    for got, want in zip(outputs["port_args"], outputs["args"]):
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert outputs["args"][0].shape == (220_500,)


def test_forward_shape(outputs):
    out = outputs["port"]
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    assert tuple(out.shape) == (HpfwConfig().n_hashprints(220_500), 2) == (380, 2)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_forward_passes_margin_audit(outputs, which):
    got = outputs[which]
    got = got.numpy().view(np.uint32) if which == "port" else got
    assert_bits_match_with_margin_audit(got, outputs["oracle"], outputs["margins"])
    assert audit.margin_audit_counts(got, outputs["oracle"], outputs["margins"])["off_free"] == 0


def test_port_and_reference_differ_only_at_free_bits(outputs):
    port = outputs["port"].numpy().view(np.uint32)
    assert_bits_match_with_margin_audit(port, outputs["ref"], outputs["margins"])
    assert audit.margin_audit_counts(port, outputs["ref"], outputs["margins"])["off_free"] == 0


def test_dryrun_is_the_meshs():
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip
