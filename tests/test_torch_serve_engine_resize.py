"""The port's engine ``resize`` and ``prewarm`` next to the same calls on
``repro.serve.SamplingEngine`` (JAX's noise replayed, the same
parameters), on both tiers: results bitwise across pool sizes, an
occupied pool refused, ``prewarm`` back at the current size."""
import pytest

torch = pytest.importorskip("torch")

from repro.serve.errors import EngineFailure as JaxEngineFailure  # noqa
from repro_torch.serve import EngineFailure  # noqa: E402
from test_torch_serve_engine_ops import (assert_same, engines,  # noqa
                                         grid, tfbind8)

torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["tfbind8", "grid"])
def test_resize_and_prewarm_keep_parity_and_refuse_an_occupied_pool(
        which, request):
    jeng, teng = engines(request.getfixturevalue(which), num_lanes=2)
    for eng, failure in ((jeng, JaxEngineFailure), (teng, EngineFailure)):
        rid = eng.submit(num_samples=3, seed=31, logit_temp=0.8)
        eng.ref = eng.run()[rid]
        assert eng.resize(5) is True and eng.num_lanes == 5
        assert eng.resize(5) is False
        rid = eng.submit(num_samples=3, seed=31, logit_temp=0.8)
        assert_same(eng.run()[rid], eng.ref)
        rid = eng.submit(num_samples=5, seed=33)
        eng.step()
        with pytest.raises(failure):
            eng.resize(7)
        assert rid in eng.run()
        eng.prewarm([2, 8])
        assert eng.num_lanes == 5
        rid = eng.submit(num_samples=3, seed=31, logit_temp=0.8)
        assert_same(eng.run()[rid], eng.ref)
    assert_same(teng.ref, jeng.ref)
    # 2 -> 5, then prewarm: 5 -> 2 -> 8 -> 5
    assert teng.counters["resizes"] == jeng.counters["resizes"] == 4
