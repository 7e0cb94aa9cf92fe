"""Host time an engine step in the server's MoE layers: the program's
own ``server.layer`` spans (``phase1.estimate``, ``gate`` with its
device-to-host copy, ``plan.lookup`` / ``phase2.finetune``, ``dispatch``)
that began in the captured window, summed, over its engine steps."""


def read(rec):
    s = rec.get("server_layer_s")
    return None if not s else 1e3 * s / rec["steps"]
