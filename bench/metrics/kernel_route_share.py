"""Share of the window's answers whose route is one hand-written kernel
launch (ServiceResult.backend), in percent."""


def read(obs):
    total = sum(obs.lanes_by_route.values())
    if not total:
        return None
    kernel = sum(n for r, n in obs.lanes_by_route.items() if r in obs.kernel_routes)
    return 100.0 * kernel / total
