"""The port's campaign layer (``repro_torch.campaign``,
``repro_torch.launch.campaign``) on the CPU.

The port of the campaign half of ``tests/test_replication.py``:

* ``CampaignSpec`` enumerates the same points and has the same digest as
  the reference's for the same spec, so a results store means the same to
  both packages: a store the reference wrote resumes in the port, and the
  port's point results equal the reference runner's;
* ``run_campaign`` runs every point as one stacked drain (2 dispatches),
  resumes every point from its store, reruns corrupt points, and a changed
  spec lands in a new directory; the store's lookups name the digest and
  the manifest guards against a digest clash; ``git_commit`` marks dirty
  trees;
* the CLI runs one small campaign on the CPU and resumes it; a campaign
  over more than one device is refused until the multi-device slice.
"""
import json
import subprocess

import pytest

pytest.importorskip("torch")
from repro.campaign import CampaignSpec as JSpec  # noqa: E402
from repro.campaign import ResultsStore as JStore  # noqa: E402
from repro.campaign import run_campaign as jrun_campaign  # noqa: E402
from repro_torch.campaign import (CampaignSpec, ResultsStore,  # noqa: E402
                                  run_campaign)
from repro_torch.campaign.store import git_commit  # noqa: E402
from repro_torch.launch import campaign as cli  # noqa: E402


def _kw(**over):
    kw = dict(
        workload="wireless",
        seeds=(0, 1, 2),
        base_model_kw=dict(n_cells=6, n_channels=2, handoff_p=0,
                           lookahead=0.5, dist="dyadic"),
        grid={"max_calls": [2, 3]},
        engine_kw=dict(lookahead=0.5, n_buckets=8, bucket_cap=64,
                       route_cap=512, fallback_cap=512),
        devices=1,
        max_epochs=200,
    )
    kw.update(over)
    return kw


def _tiny_spec(**over):
    return CampaignSpec(**_kw(**over))


SPECS = [dict(), dict(seeds=(5, 6)),
         dict(grid={"max_calls": [2, 3], "hot_streams": [0, 1]}),
         dict(grid={}, max_epochs=64, engine_kw=dict(lookahead=0.5))]


@pytest.mark.parametrize("over", SPECS, ids=range(len(SPECS)))
def test_points_and_digest_equal_the_reference(over):
    mine, ref = CampaignSpec(**_kw(**over)), JSpec(**_kw(**over))
    assert mine.points() == ref.points()
    assert [mine.point_label(i) for i in range(len(mine.points()))] \
        == [ref.point_label(i) for i in range(len(ref.points()))]
    assert mine.as_dict() == ref.as_dict()
    assert mine.digest() == ref.digest()


def test_campaign_grid_enumeration_is_deterministic():
    spec = _tiny_spec(grid={"max_calls": [2, 3], "hot_streams": [0, 1]})
    pts = spec.points()
    assert len(pts) == 4 and pts == spec.points()
    assert all(p["handoff_p"] == 0 for p in pts)
    assert sorted((p["max_calls"], p["hot_streams"]) for p in pts) \
        == [(2, 0), (2, 1), (3, 0), (3, 1)]
    assert spec.digest() != _tiny_spec().digest()
    assert _tiny_spec().digest() != _tiny_spec(seeds=(0, 1)).digest()
    with pytest.raises(ValueError, match="duplicate"):
        _tiny_spec(seeds=(1, 1))


def test_campaign_runs_then_resumes_from_store(tmp_path):
    spec = _tiny_spec()
    store = ResultsStore(tmp_path / "results")

    first = run_campaign(spec, store=store, device="cpu")
    assert (first["ran"], first["resumed"]) == (2, 0)
    assert first["missing"] == [] and first["unclean"] == []
    assert first["undrained"] == []
    for res in first["results"]:
        assert res["dispatches"] == 2  # ingest + one stacked drain
        assert [rep["seed"] for rep in res["replications"]] == [0, 1, 2]
        assert all(rep["in_flight"] == 0 for rep in res["replications"])

    second = run_campaign(spec, store=store, device="cpu")
    assert (second["ran"], second["resumed"]) == (0, 2)
    assert [r["replications"] for r in second["results"]] \
        == [r["replications"] for r in first["results"]]

    other = _tiny_spec(seeds=(5, 6))
    assert store.run_dir(other) != store.run_dir(spec)
    assert store.missing(other) == [0, 1]


def test_point_results_equal_the_reference_runner(tmp_path):
    spec, jspec = _tiny_spec(), JSpec(**_kw())
    mine = run_campaign(spec, store=ResultsStore(tmp_path / "port"),
                        device="cpu")
    ref = jrun_campaign(jspec, store=JStore(tmp_path / "ref"))
    assert mine["digest"] == ref["digest"]
    for a, b in zip(mine["results"], ref["results"]):
        assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))
    # the reference's store resumes in the port, point for point.
    again = run_campaign(spec, store=ResultsStore(tmp_path / "ref"),
                         device="cpu")
    assert (again["ran"], again["resumed"]) == (0, 2)


def test_campaign_resume_reruns_corrupt_points(tmp_path):
    spec = _tiny_spec()
    store = ResultsStore(tmp_path / "results")
    first = run_campaign(spec, store=store, device="cpu")
    assert store.missing(spec) == []

    store._point_path(spec, 0).write_text("")            # zero-byte
    store._point_path(spec, 1).write_text("{\"trunc")    # torn write
    assert not store.has(spec, 0) and not store.has(spec, 1)
    assert store.missing(spec) == [0, 1]

    second = run_campaign(spec, store=store, device="cpu")
    assert (second["ran"], second["resumed"]) == (2, 0)
    assert [r["replications"] for r in second["results"]] \
        == [r["replications"] for r in first["results"]]
    assert store.missing(spec) == []


def test_store_get_names_digest_and_index_when_absent(tmp_path):
    spec = _tiny_spec()
    store = ResultsStore(tmp_path)
    with pytest.raises(KeyError, match=f"{spec.digest()[:12]}.*point 1"):
        store.get(spec, 1)


def test_git_commit_marks_dirty_trees(tmp_path):
    assert git_commit(cwd=str(tmp_path)) == "unknown"
    repo = tmp_path / "repo"
    repo.mkdir()

    def g(*a):
        subprocess.run(["git", "-c", "user.email=t@example.com",
                        "-c", "user.name=t", *a], cwd=repo, check=True,
                       capture_output=True)
    g("init")
    g("commit", "--allow-empty", "-m", "seed")
    clean = git_commit(cwd=str(repo))
    assert len(clean) == 40 and not clean.endswith("+dirty")
    (repo / "f.txt").write_text("untracked counts as dirty too")
    assert git_commit(cwd=str(repo)) == clean + "+dirty"
    g("add", "f.txt")
    assert git_commit(cwd=str(repo)) == clean + "+dirty"
    g("commit", "-m", "add f")
    committed = git_commit(cwd=str(repo))
    assert committed != clean and not committed.endswith("+dirty")


def test_campaign_manifest_guards_against_digest_mismatch(tmp_path):
    spec = _tiny_spec()
    store = ResultsStore(tmp_path)
    store.write_manifest(spec)
    store.write_manifest(spec)  # idempotent
    clash = _tiny_spec(seeds=(9,))
    store.run_dir(clash).mkdir(parents=True, exist_ok=True)
    manifest = store.run_dir(spec) / "manifest.json"
    (store.run_dir(clash) / "manifest.json").write_text(manifest.read_text())
    with pytest.raises(ValueError, match="different campaign"):
        store.write_manifest(clash)


def test_campaign_over_devices_is_refused(tmp_path):
    store = ResultsStore(tmp_path)
    with pytest.raises(NotImplementedError, match="multi-device") as e:
        run_campaign(_tiny_spec(devices=2), store=store, device="cpu")
    assert "rep-sharded" in str(e.value)
    assert not any(tmp_path.iterdir())      # refused before the manifest


def test_cli_runs_a_small_campaign_on_the_cpu(tmp_path, capsys):
    argv = ["--workload", "wireless", "--seeds", "3", "--grid",
            "max_calls=2,3", "--model-kw", "n_cells=6", "--model-kw",
            "n_channels=2", "--model-kw", "handoff_p=0", "--epochs", "200",
            "--n-buckets", "8", "--bucket-cap", "64", "--route-cap", "512",
            "--fallback-cap", "512", "--store", str(tmp_path),
            "--require-drained", "--device", "cpu"]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "2 points ran, 0 resumed" in out and "complete" in out
    assert "on cpu" in out
    cli.main(argv)
    assert "0 points ran, 2 resumed" in capsys.readouterr().out
    (run_dir,) = tmp_path.iterdir()
    points = sorted(p.name for p in run_dir.glob("point-*.json"))
    assert points == ["point-0.json", "point-1.json"]
    res = json.loads((run_dir / "point-1.json").read_text())
    assert res["dispatches"] == 2 and res["drained"]
    assert [r["seed"] for r in res["replications"]] == [0, 1, 2]
    # a too-short bound leaves events in flight: fatal under
    # --require-drained.
    short = argv[:argv.index("--epochs") + 1] + ["3"] \
        + argv[argv.index("--epochs") + 2:]
    with pytest.raises(SystemExit):
        cli.main(short)
    assert "hit the 3-epoch bound" in capsys.readouterr().out


def test_cli_parsers_equal_the_reference():
    from repro.launch.campaign import parse_grid
    from repro.launch.simulate import parse_kv
    kv = ["a=1", "b=x", "c=0.5", "d=(1, 2)", "e=None", "f=a=b"]
    assert cli.parse_kv(kv) == parse_kv(kv)
    assert cli.parse_kv(["a=1", "b=x"]) == {"a": 1, "b": "x"}
    grid = ["k=1,2", "s=a,b", "f=0.5,True"]
    assert cli.parse_grid(grid) == parse_grid(grid)
    with pytest.raises(SystemExit):
        cli.parse_kv(["nokey"])
    with pytest.raises(SystemExit):
        cli.parse_grid(["k=1", "k=2"])
