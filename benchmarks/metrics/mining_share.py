"""Share of the training window spent in the trainer's mining refreshes
(``StepTimer``'s ``mining_refresh`` spans), in %."""


def read(name, r):
    if r.get("kind") != "train" or not r.get("window_s"):
        return None
    return 100.0 * r["refresh_s"] / r["window_s"]
