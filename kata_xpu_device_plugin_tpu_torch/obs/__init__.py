"""Guest-side observability helpers of the port."""
