"""Host-side monitor state the port needs: the feature-history buffer."""
