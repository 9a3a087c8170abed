"""disc100 (graded config 3: TreePM, a central sink, fixed h) at the
script's smoke N, two segments of four steps through the port's
`tools.evidence.run` against the JAX package, in float64 on the CPU
(`test_torch_evidence.two_segments_against_jax`)."""

from summersph_tpu_torch.integrate import check_health

from test_torch_evidence import two_segments_against_jax


def test_two_segments_match_jax(monkeypatch, tmp_path):
    state = two_segments_against_jax(monkeypatch, tmp_path, "disc100")
    check_health(state)
    assert not any(state.stats.tolist())
