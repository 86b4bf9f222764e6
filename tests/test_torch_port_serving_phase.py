"""``chip_smoke.py``'s ``serving`` phase (phase 17) at a small size on the
CPU: the keyed DLRM panel over ``ThreadWorld(4)`` against its int64 and
float64 oracles and a world-1 panel, the NCF hit-rate table against the
int64 rank count, the admission ladder under a seeded spike, and the
decode ``StreamTable`` with its sampled requests held bitwise to the
standalone streaming metrics across an elastic 4->2 restore. The CUDA
graphs, the profiler rows and the capture checks need the card."""

from __future__ import annotations

import chip_smoke

CPU = "cpu"


def test_phase_serving_small_on_cpu():
    out = chip_smoke.phase_serving(
        CPU, rows=5000, batch=2048, batches=8, world=4, drain_every=4, ncf_users=3000,
        ncf_candidates=100, ncf_batch=1024, calm_steps=6, spike_steps=6, tail_steps=4,
        request_rows=64, keyspace=256, requests=400, active=160, decode_steps=20, ngram_steps=6,
        sampled=8, decode_drain_every=5, vocab=1000, seed=3,
    )
    assert out["phase"] == "serving" and out["k1_launches"] == 0
    panel = out["panel"]
    assert panel["ctr_bitwise"] and panel["ingest"] is None  # timing needs the card
    assert len(panel["drain_s"]) == 2 and len(panel["per_rank_bytes"]) == 4
    assert max(panel["payload_bytes"]["ranks"]) < panel["payload_bytes"]["world1"]
    assert out["ncf"]["bitwise"] and out["ncf"]["users"] == 3000
    adm = out["admission"]
    assert set(adm["rungs"]["spike"]) == {1} and adm["rungs"]["tail"][-1] == 0
    assert adm["admitted_keys_check"]["ctr_bitwise"] and adm["shed_rows_total"] > 0
    dec = out["decode"]
    assert dec["checked"]["before_restore"] > 0 and dec["checked"]["after_restore"] > 0
    assert dec["checked"]["ngram"] > 0
    assert dec["logprob_token_edit_ngram"]["ngram_mirror_host_us_per_step"] > 0
