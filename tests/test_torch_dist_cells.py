"""The dry-run's smoke cells on a fake (2, 4) mesh under the flatten guard
(``repro_torch.launch.guard``; ``test_torch_dist_train.py`` holds the
other five train cells and ``constrain``'s transpose): the train cells of five archs, and
the prefill and decode cells of every arch but smollm-360m, whose cells
``test_torch_launch.py`` runs; and the one-sequence decode (``long_500k``)
of the two archs that run it, on a (2, 8) mesh whose model axis divides
no head count of hymba's and whose data axis cannot take a batch of one.
Each must end ``ok`` with nothing the guard records."""
import pytest

from repro_torch.configs import ARCH_IDS, SHAPES

from test_torch_dist_train import assert_cell_clean


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-34b", "mamba2-370m",
                                  "granite-moe-3b-a800m", "llava-next-mistral-7b"])
def test_train_cell_runs_with_no_sharded_flatten(arch):
    assert_cell_clean(arch, "train")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "smollm-360m"])
def test_serving_cell_runs_with_no_sharded_flatten(arch, kind):
    assert_cell_clean(arch, kind)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smollm_serving_cells_have_no_sharded_flatten(kind):
    assert_cell_clean("smollm-360m", kind)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_one_sequence_decode_cell_runs_with_no_sharded_view(arch):
    assert_cell_clean(arch, SHAPES["long_500k"], mesh_shape=(2, 8))


def test_dryrun_cli_runs_cells_as_processes(tmp_path):
    """``--jobs``: each cell in a CLI process of its own, the records merged
    into ``--out`` (here the cells the full-attention archs skip, which
    trace nothing); ``--skip-done`` then leaves them."""
    from repro_torch.launch import dryrun

    out = str(tmp_path / "dryrun.json")
    argv = ["--arch", "smollm-360m", "--shape", "long_500k", "--mesh", "both", "--jobs", "2",
            "--out", out]
    dryrun.main(argv)
    recs = dryrun.load_results(out)
    assert sorted((r["mesh"], r["status"]) for r in recs) == [("16x16", "skipped"),
                                                             ("2x16x16", "skipped")]
    assert all(r["reason"].startswith("full-attention arch") for r in recs)
    assert sorted(p.name for p in (tmp_path / "dryrun.json.cells").glob("*.json")) == [
        "smollm-360m.long_500k.multi.json", "smollm-360m.long_500k.single.json"]
    dryrun.main(argv + ["--skip-done"])
    assert dryrun.load_results(out) == recs
