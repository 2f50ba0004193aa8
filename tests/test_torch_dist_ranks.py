"""The MoE and Whisper train steps on four gloo ranks (a 2x2 mesh)
against one device, under ``full``: the loss within 1e-5 relative, every
parameter's ``full_tensor()`` after the step within 1e-5 relative L2.
The MoE step on one device runs with the mesh ambient, so both dispatch
in the mesh's dp = 2 groups.  ``cross_entropy`` and its gradient on
logits whose vocabulary is sharded over "model" within 1e-6 of plain
logits.  The checks are ``repro_torch.launch.parity``'s, which
``chip_smoke.py`` runs on the card machine's torch."""
import json
import re

from test_torch_dist import _run_ranks


def test_moe_and_whisper_train_steps_on_four_ranks(tmp_path):
    out = _run_ranks("""
        def main(rank, mesh):
            import json
            import sys
            from repro_torch.launch.parity import TOL, cross_entropy_parity, train_parity

            recs = [cross_entropy_parity(mesh)]
            recs += [train_parity(mesh, a) for a in ("granite-moe-3b-a800m", "whisper-large-v3")]
            for rec in recs:
                assert rec["ok"], rec
                if rank == 0:    # one write a line: the ranks share the pipe
                    sys.stdout.write("REC " + json.dumps(rec) + "\\n")
                    sys.stdout.flush()
            print("MATCH", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path, timeout=400)
    assert out.count("MATCH") == 4
    recs = [json.loads(m) for m in re.findall(r"REC (\{[^{}]*\})", out)]
    assert [r.get("arch") for r in recs] == [None, "granite-moe-3b-a800m", "whisper-large-v3"]
    for r in recs[1:]:
        assert r["loss_rel"] <= 1e-5 and r["param_rel_max"] <= 1e-5, r
