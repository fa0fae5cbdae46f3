"""The load of the busiest held expert over the held experts' mean, from the program's counters: the largest held
expert's (token, expert) pairs summed over the expert layers' forwards (``rechub.moe.max_expert_pairs``), over the
pairs that fell on held experts (``rechub.moe.routed_pairs``) divided by the experts held (``n_routed_experts``).
1 is an even load; the slowest expert's product sets the experts' time.  ``None`` where the program keeps no such
counters."""


def read(ctx):
    from torch_rechub_tpu_torch.utils import profiling

    counts = getattr(profiling, "counters", lambda: {})()
    pairs, busiest = counts.get("rechub.moe.routed_pairs"), counts.get("rechub.moe.max_expert_pairs")
    if not pairs or busiest is None:
        return None
    return busiest / (pairs / ctx.cfg["n_routed_experts"])
