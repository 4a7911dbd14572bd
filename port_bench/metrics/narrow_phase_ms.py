"""Host milliseconds a step of the port's `narrow_phase` stage less its
`gjk_epa` stage (the analytic pair kernels and box-box clipping), between
the markers' synchronisations."""


def read(run):
    st = run.get("stages", {})
    return None if "narrow_phase" not in st else st["narrow_phase"] - st.get("gjk_epa", 0.0)
