"""Round-2 correctness fixes: fit_tanh coverage, loud flag rejection,
bdb error, multi-leaf force barrier."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cryo_ralib_tpu.config import AlignConfig
from cryo_ralib_tpu.ops.fsc import fit_tanh
from cryo_ralib_tpu.utils.profiling import force


def _tanh_response(freqs, fl, aa):
    c = np.pi / (2.0 * aa * fl)
    return 0.5 * (np.tanh(c * (freqs + fl)) - np.tanh(c * (freqs - fl)))


class TestFitTanh:
    def test_recovers_known_parameters(self):
        # build an FSC curve whose two-halves-adjusted form IS the tanh
        # response for known (fl, aa): vals = resp / (2 - resp) inverts
        # the 2f/(1+f) map inside fit_tanh
        freqs = np.arange(46) / 90.0
        fl_true, aa_true = 0.20, 0.10
        resp = _tanh_response(freqs, fl_true, aa_true)
        vals = resp / (2.0 - resp)
        fl, aa = fit_tanh((freqs, vals))
        assert abs(fl - fl_true) < 0.02
        assert abs(aa - aa_true) < 0.05

    def test_perfect_correlation_curve(self):
        freqs = np.arange(46) / 90.0
        vals = np.ones(46)
        fl, aa = fit_tanh((freqs, vals))
        assert np.isfinite(fl) and np.isfinite(aa)
        assert 0.01 <= fl <= 0.49 and 0.01 <= aa <= 0.49
        # an all-1 curve means full resolution: cutoff should be high
        assert fl > 0.3

    def test_zero_curve_does_not_explode(self):
        freqs = np.arange(46) / 90.0
        vals = np.zeros(46)
        fl, aa = fit_tanh((freqs, vals))
        assert np.isfinite(fl) and np.isfinite(aa)
        assert 0.01 <= fl <= 0.49 and 0.01 <= aa <= 0.49

    def test_negative_dc_term_handled(self):
        freqs = np.arange(46) / 90.0
        vals = _tanh_response(freqs, 0.25, 0.1)
        vals = vals / (2.0 - vals)
        vals[0] = -1.0  # SPHIRE flips a negative DC term
        fl, aa = fit_tanh((freqs, vals))
        assert np.isfinite(fl) and 0.01 <= fl <= 0.49


class TestFlagHonesty:
    def _args(self, **kw):
        import argparse

        from cryo_ralib_tpu.cli.common import add_common_flags

        p = argparse.ArgumentParser()
        add_common_flags(p, reffree=True)
        argv = []
        for k, v in kw.items():
            if v is True:
                argv.append(f"--{k}")
            else:
                argv.append(f"--{k}={v}")
        return p.parse_args(argv)

    def test_defaults_pass(self):
        from cryo_ralib_tpu.cli.common import validate_reffree_flags

        validate_reffree_flags(self._args())  # no raise

    @pytest.mark.parametrize("kw", [
        {"dst": 90.0, "random_method": "SHC"},
        {"dst": 90.0, "random_method": "SCF"},
    ])
    def test_unimplemented_flags_rejected(self, kw):
        from cryo_ralib_tpu.cli.common import validate_reffree_flags

        with pytest.raises(SystemExit):
            validate_reffree_flags(self._args(**kw))

    @pytest.mark.parametrize("kw", [
        {"mode": "H"}, {"random_method": "SHC"}, {"nomirror": True},
        {"Fourvar": True}, {"dst": 90.0}, {"random_method": "SCF"},
    ])
    def test_r3_capability_flags_accepted(self, kw):
        # real capability since r3; must validate
        from cryo_ralib_tpu.cli.common import validate_reffree_flags

        validate_reffree_flags(self._args(**kw))  # no raise


def test_bdb_missing_database_errors_clearly():
    # bdb: containers are READ since r3 (io/bdb.py); a missing database
    # must fail with a pointed message rather than conversion guidance
    from cryo_ralib_tpu.cli.common import load_stack

    with pytest.raises(FileNotFoundError, match="no such database"):
        load_stack("bdb:particles#stack")


def test_force_touches_every_leaf():
    # force() must fetch from every leaf (leaves can come from different
    # executables); complex leaves are fetched via their real part
    tree = {"a": jnp.ones((4,)), "b": jnp.ones((2, 2), jnp.complex64),
            "c": 3, "d": jnp.zeros((1,), jnp.int32)}
    force(tree)  # completes without error
