"""Host-device synchronisations a step inside the port's `step` span in the
recorded phase of a traced run (`recorded.py`): each warning of torch.cuda's
sync debug mode, counted by the port's recorder."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "step", "syncs")
