"""Host milliseconds a step of the port's `broad_phase` stage, between the
synchronisations its marker makes (the stage steps of a traced run)."""


def read(run):
    return run.get("stages", {}).get("broad_phase")
