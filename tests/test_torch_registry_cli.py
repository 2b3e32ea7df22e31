"""The port's env registry and training CLI against the JAX package's
(``repro.envs.registry``, ``python -m repro.run``).

- ``--list-envs`` prints JAX's lines, line for line; every entry has JAX's
  fields and its factory JAX's defaults.
- ``--help`` lists every JAX flag but the execution-plan ones.
- Exit codes and refusals: an unknown env or recipe, a bad or unsupported
  transform exit 2; a recipe with a run function of its own refuses a
  foreign env, a sampler and the checkpoint flags, and warns about
  ``--metrics-json``; no arguments list the recipes.
- ``--cfg`` reaches the config and the optimizer.
- The metrics JSON has JAX's keys, steps and ``metric_names`` for the same
  small recipe (the values differ: each package draws its own noise).
- ``reward_cache`` on the hypergrid trains bitwise as the bare env.
"""
import inspect
import json
import re

import pytest

torch = pytest.importorskip("torch")

from repro import run as jax_run  # noqa: E402
from repro.envs import registry as jreg  # noqa: E402
from repro_torch import recipes, run  # noqa: E402
from repro_torch.envs import registry as treg  # noqa: E402

torch.set_num_threads(2)

SMALL = ["--set", "dim=2", "--set", "side=4", "--device", "cpu"]


def _quiet(_):
    pass


def _out(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


def test_list_envs_equals_jax_line_for_line(capsys):
    rc, tout = _out(run.main, ["--list-envs"], capsys)
    jrc, jout = _out(jax_run.main, ["--list-envs"], capsys)
    assert rc == jrc == 0
    assert tout.out.splitlines() == jout.out.splitlines()
    assert len(tout.out.splitlines()) == 9


@pytest.mark.parametrize("name", sorted(jreg.ENVS))
def test_registry_entries_match_jax(name):
    j, t = jreg.get_env(name), treg.get_env(name)
    for field in ("name", "description", "recipe", "smoke_overrides",
                  "transforms", "serving", "action_space"):
        assert getattr(t, field) == getattr(j, field), field
    jsig = inspect.signature(j.make).parameters
    tsig = inspect.signature(t.make).parameters
    assert {k: p.default for k, p in tsig.items()} == \
        {k: p.default for k, p in jsig.items()}
    assert t.recipe in recipes.train_names()


def _flags(text):
    """The options argparse's help lists, one per line of its table."""
    return set(re.findall(r"^ +(?:-\w, )?(--[a-z][a-z-]*)", text, re.M))


def test_help_lists_jax_flags_but_the_plan_ones(capsys):
    """Every flag of JAX's CLI, the three plan flags among them, with
    JAX's plan choices; the port adds only ``--device``."""
    for main in (run.main, jax_run.main):
        with pytest.raises(SystemExit):
            main(["--help"])
    text = capsys.readouterr().out
    tflags = _flags(text[:text.index("usage: python -m repro.run")])
    jflags = _flags(text[text.index("usage: python -m repro.run"):])
    plan = {"--plan", "--devices", "--num-seeds"}
    assert plan <= tflags and jflags <= tflags
    assert tflags - jflags == {"--device"}
    assert "not ported" not in text
    tchoices = re.search(r"--plan \{([^}]*)\}", text).group(1)
    jchoices = re.findall(r"--plan \{([^}]*)\}", text)[-1]
    assert tchoices == jchoices


@pytest.mark.parametrize("argv", [[], ["--list"]])
def test_no_arguments_list_the_recipes(argv, capsys):
    rc, out = _out(run.main, argv, capsys)
    assert rc == 0
    names = [line.split()[0] for line in out.out.splitlines()]
    assert names == recipes.train_names()


@pytest.mark.parametrize("argv,msg", [
    (["--env", "nope"], "unknown env 'nope'"),
    (["--recipe", "nope"], "unknown recipe 'nope'"),
    (["--env", "hypergrid", "--transform", "nope"], "bad transform spec"),
    (["--env", "hypergrid", "--transform", "beta"], "bad transform spec"),
    (["--env", "box", "--transform", "reward_cache"],
     "does not support transform 'reward_cache'"),
    (["--env", "ising", "--transform", "beta=2.0"],
     "does not support transform 'reward_exponent'")])
def test_exit_codes_match_jax(argv, msg, capsys):
    rc, out = _out(run.main, argv, capsys)
    jrc, jout = _out(jax_run.main, argv, capsys)
    assert rc == jrc == 2
    assert msg in out.err and msg in jout.err


def test_run_override_refusals():
    with pytest.raises(ValueError, match="constructs its own environment"):
        run.run_recipe("ising_ebgfn", env_name="hypergrid", device="cpu")
    with pytest.raises(ValueError, match="--sampler is not supported"):
        run.run_recipe("ising_ebgfn", sampler="replay", device="cpu")
    with pytest.raises(ValueError, match="--checkpoint-every/--restore"):
        run.run_recipe("ising_ebgfn", checkpoint_every=5, device="cpu")
    with pytest.raises(ValueError, match="--checkpoint-every/--restore"):
        run.run_recipe("ising_ebgfn", restore=True, device="cpu")


def test_registered_run_override_gets_the_run_and_a_metrics_warning():
    seen, lines = {}, []

    def own_run(**kw):
        seen.update(kw)
        return {"recipe": "custom_override"}

    base = recipes.get_train("ising_ebgfn")
    recipes.register(base._replace(name="custom_override",
                                   run_override=own_run))
    try:
        out = run.run_recipe("custom_override", iterations=3, device="cpu",
                             metrics_json="x.json", config={"alpha": 0.3},
                             transforms=("identity",), log=lines.append)
    finally:
        recipes._TRAIN_RECIPES.pop("custom_override")
    assert out == {"recipe": "custom_override"}
    assert seen["iterations"] == 3 and seen["config"] == {"alpha": 0.3}
    assert seen["transforms"] == ("identity",)
    assert any("--metrics-json is ignored" in s for s in lines)


def test_cfg_reaches_config_and_optimizer(capsys):
    out = run.run_recipe("hypergrid_tb", iterations=2, eval_every=0,
                         env={"dim": 2, "side": 4}, device="cpu",
                         config={"lr": 3e-4, "max_grad_norm": 1.0,
                                 "weight_decay": 1e-3}, log=_quiet)
    cfg = out["loop"].cfg
    assert (cfg.lr, cfg.max_grad_norm, cfg.weight_decay) == (3e-4, 1.0, 1e-3)
    opt = out["state"].optimizer
    assert isinstance(opt, torch.optim.AdamW)
    assert sorted(g["lr"] for g in opt.param_groups) == [3e-4, 1e-1]
    with pytest.raises(ValueError):
        run.run_recipe("hypergrid_tb", iterations=1, eval_every=0,
                       env={"dim": 2, "side": 4}, device="cpu",
                       config={"no_such_field": 1}, log=_quiet)
    rc, text = _out(run.main, ["--recipe", "hypergrid_tb", "--iterations",
                               "2", "--eval-every", "0", "--cfg",
                               "lr=3e-4", "--cfg", "max_grad_norm=0.5"]
                    + SMALL, capsys)
    assert rc == 0 and "trained hypergrid_tb for 2 iterations" in text.out


def test_metrics_json_matches_jax_schema(tmp_path, capsys):
    argv = ["--recipe", "hypergrid_tb", "--iterations", "3",
            "--eval-every", "2", "--eval-batch", "64", "--set", "dim=2",
            "--set", "side=4"]
    assert run.main(argv + ["--device", "cpu", "--metrics-json",
                            str(tmp_path / "t.json")]) == 0
    assert jax_run.main(argv + ["--metrics-json",
                                str(tmp_path / "j.json")]) == 0
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert t.keys() == j.keys()
    for k in ("schema_version", "recipe", "seed", "iterations",
              "eval_every", "eval_batch", "metric_names"):
        assert t[k] == j[k], k
    assert t["schema_version"] == run.METRICS_SCHEMA_VERSION == 1
    assert [r["step"] for r in t["rows"]] == [r["step"] for r in j["rows"]] \
        == [0, 2]
    assert [list(r) for r in t["rows"]] == [list(r) for r in j["rows"]]
    assert "wrote metrics JSON" in capsys.readouterr().out


def test_reward_cache_trains_as_the_bare_env(capsys):
    kw = dict(env_name="hypergrid", env={"dim": 2, "side": 4},
              iterations=3, eval_every=0, device="cpu", log=_quiet)
    bare = run.run_recipe(**kw)
    lines = []
    cached = run.run_recipe(transforms=("reward_cache",),
                            **dict(kw, log=lines.append))
    assert lines[0] == "transforms: reward_cache (outermost first)"
    for a, b in zip(bare["history"], cached["history"]):
        assert [a[k] for k in ("loss", "log_z", "mean_log_reward")] == \
            [b[k] for k in ("loss", "log_z", "mean_log_reward")]
    assert bare["recipe"] == cached["recipe"] == "hypergrid_tb"
