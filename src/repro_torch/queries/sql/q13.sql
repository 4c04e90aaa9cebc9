with go as (
    select o_custkey, count(*) as c_count
    from orders
    where o_comment not like '%special%requests%'
    group by o_custkey
)
select /*+ groups(256) */ c_count, count(*) as custdist
from customer
    left join go on c_custkey = o_custkey
group by c_count
order by custdist desc, c_count desc
