"""varh (graded config 4: grad-h variable h with the Newton iteration,
TreePM, a central sink) at the script's smoke N, two segments of four
steps through the port's `tools.evidence.run` against the JAX package, in
float64 on the CPU (`test_torch_evidence.two_segments_against_jax`)."""

from summersph_tpu_torch.integrate import check_health

from test_torch_evidence import two_segments_against_jax


def test_two_segments_match_jax(monkeypatch, tmp_path):
    state = two_segments_against_jax(monkeypatch, tmp_path, "varh")
    check_health(state)
    d = state.stats_dict()
    assert not any(v for k, v in d.items()
                   if k not in ("h_unconverged", "sph_clamped"))
