"""The bytes the Γ-point fold and unfold read and write (the real bands'
half spheres and the complex full-sphere rows, each once, both passes), in
GB per pair: the program's own count, the ``fold_bytes`` and
``unfold_bytes`` counters of its ``gamma`` probe over the window, over the
pairs.  None where the program keeps no such counters or the run was not
traced."""


def read(facts):
    counted = facts.get("gamma_window") or {}
    total = counted.get("fold_bytes", 0) + counted.get("unfold_bytes", 0)
    if facts.get("trace") is None or not facts.get("pairs") or not total:
        return None
    return total / 1e9 / facts["pairs"]
