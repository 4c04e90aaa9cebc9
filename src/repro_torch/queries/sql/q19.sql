select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem
    join part on l_partkey = p_partkey
where l_shipinstruct = 'DELIVER IN PERSON'
  and l_shipmode in ('AIR', 'AIR REG')
  and (p_brand = 'Brand#12'
         and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
         and p_size >= 1 and p_size <= 5
       or p_brand = 'Brand#23'
         and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
         and p_size >= 1 and p_size <= 10
       or p_brand = 'Brand#34'
         and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
         and p_size >= 1 and p_size <= 15)
  and (p_brand = 'Brand#12' and l_quantity >= 1 and l_quantity <= 11
       or p_brand = 'Brand#23' and l_quantity >= 10 and l_quantity <= 20
       or p_brand = 'Brand#34' and l_quantity >= 20 and l_quantity <= 30)
