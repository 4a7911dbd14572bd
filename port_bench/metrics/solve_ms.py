"""Host milliseconds a step of the port's `solve` stage less its `joints`
stage (coloring and the contact solve), between the markers'
synchronisations."""


def read(run):
    st = run.get("stages", {})
    return None if "solve" not in st else st["solve"] - st.get("joints", 0.0)
