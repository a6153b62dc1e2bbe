"""B1's byte bound over its device time (%) in the traced epoch: every
cloud forward of the steps and of the validation."""

from portbench.readers import knn_roofline_pct, train_forward_clouds


def read(r):
    return knn_roofline_pct(r, clouds=train_forward_clouds(r))
