"""Host milliseconds a step of the port's `gjk_epa` stage (the generic
convex pairs' GJK/EPA), between the markers' synchronisations; nothing
where no step ran it."""


def read(run):
    return run.get("stages", {}).get("gjk_epa")
