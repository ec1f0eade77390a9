"""``loop_outside_pct.train`` (%): the window's share outside the ``step_fn``
calls, from the harness's host spans around the step it hands to
``cli/common.py::run_train_loop``. Layer: the training loop
(``run_train_loop``, ``data/loader.py``'s ``DevicePrefetcher`` and
``stage_batch``)."""


def read(run, info):
    share = info.get("outside_share")
    return None if share is None else 100.0 * share
