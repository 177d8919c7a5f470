"""The bytes the pair-density product reads and writes (each conduction
cube read and written, the valence conjugate read), in GB per pair: the
program's own count, the ``product_bytes`` counter of its ``mtxel`` probe
over the window, over the pairs.  None where the program keeps no such
counter or the run was not traced."""


def read(facts):
    counted = (facts.get("mtxel_window") or {}).get("product_bytes")
    if facts.get("trace") is None or not facts.get("pairs") or not counted:
        return None
    return counted / 1e9 / facts["pairs"]
